"""The int8 MLP's c_fc with its rows quantised on chip (gemm_s8_quant,
csrc/gemm_s8_quant.cu) on the CPU: its plain version against the JAX
package's in-kernel stages, and the wrapper's geometry rule.

The plain version, int8.w8a8_gelu_quant_plain, is held against
``_w8a8_dot + bias``, QuickGELU in f32 and ``_quant_rows``
(dfd_clip_tpu/ops/pallas_attention.py:158, 173, 1259-1262) on the same
numpy inputs: scales exactly equal, int8 values within 1 on at most 1e-5 of
the elements (the existing _quant_rows hold: the quotient 127 / s may round
apart). The kernel itself runs only on the card: tests/test_torch_port_cuda.py
and chip_smoke.py hold it bit for bit against gemm_s8's QuickGELU form
followed by quant_rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.models import clip_vit as jvit
from dfd_clip_tpu.ops import pallas_attention as jpa
from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import int8 as ti

TEST_WIDTH = jvit.ARCHITECTURES["ViT-Test"].width


def int8_flips(got, want):
    """(largest |difference|, share of elements that differ) of int8 arrays."""
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return d.max(), (d > 0).mean()


@pytest.mark.parametrize("k,n", [(TEST_WIDTH, 4 * TEST_WIDTH), (768, 3072), (1024, 4096)],
                         ids=["vit_test", "vit_b", "vit_l"])
def test_w8a8_gelu_quant_plain_matches_jax(k, n):
    """A few rows at ViT-Test's width and at ViT-B/16's and ViT-L/14's c_fc
    shapes (K -> 4K): LN2's quantised rows through the W8A8 product, the
    bias, QuickGELU and the rows' quantiser, against the TPU kernels'
    stages."""
    rng = np.random.default_rng(n)
    y = rng.standard_normal((96, k)).astype(np.float32)
    w = (k ** -0.5 * rng.standard_normal((k, n))).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    yq, ys = jpa._quant_rows(jnp.asarray(y))
    wq, ws = jpa.quantize_weight(jnp.asarray(w))
    mid = jpa._w8a8_dot(yq, ys, wq, ws) + jnp.asarray(b)
    jq, js = jpa._quant_rows(mid * jax.nn.sigmoid(1.702 * mid))
    tq, ts = ti.w8a8_gelu_quant_plain(
        torch.from_numpy(np.array(yq)), torch.from_numpy(np.array(ys)),
        torch.from_numpy(np.array(wq)).t().contiguous(), torch.from_numpy(np.array(ws)),
        torch.from_numpy(b))
    assert tq.dtype == torch.int8 and tq.shape == (96, n) and ts.shape == (96, 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    worst, share = int8_flips(tq.numpy(), jq)
    assert worst <= 1 and share <= 1e-5, (worst, share)


@pytest.mark.parametrize("n,cluster,tile", [(3072, 8, 384), (4096, 8, 512), (1024, 2, 512),
                                            (768, 2, 384), (512, 1, 512), (2560, 5, 512)])
def test_quant_geometry_covers_whole_rows(n, cluster, tile):
    """ViT-B/16's 3072 and ViT-L/14's 4096 columns: a cluster of 8 CTAs
    (two consumer warpgroups each, of 192 or 256 columns) holds a whole row;
    a power-of-two cluster where a tile gives one, else 512-column tiles."""
    assert _cuda.quant_geometry(n) == (cluster, tile)
    assert cluster * tile == n and cluster <= 8


@pytest.mark.parametrize("n", [3000, 4608, 5120, 200, 0])
def test_quant_geometry_refuses_widths_it_cannot_tile(n):
    """A width that is not a multiple of 512 or 384, or needs a cluster of
    more than 8 CTAs, raises: no path falls back to the f32 pair by width."""
    with pytest.raises(ValueError, match="cannot tile"):
        _cuda.quant_geometry(n)


def test_gemm_s8_quant_takes_cuda_tensors_only():
    """The launcher raises on CPU tensors instead of computing anything (the
    int8 blocks take their plain versions by the device of h)."""
    m, k, n = 4, 64, 512
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.gemm_s8_quant(torch.zeros(m, k, dtype=torch.int8), torch.ones(m),
                            torch.zeros(n, k, dtype=torch.int8), torch.ones(n), torch.zeros(n))
