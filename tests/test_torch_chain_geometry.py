"""Host side of the megakernel probe's chained product (dfd_clip_tpu_torch on
the CPU): the shapes the wrappers take and refuse (_cuda.chain_shape), and
the entries' contracts on CPU tensors. The launch's geometry (panels,
units, grid, shared memory) is csrc/gemm_chain.cu's own, read on the card
through _cuda.chain_geometry. The kernels run on the card
(tests/test_torch_port_cuda.py::test_gemm_chain_entries); on the CPU each
entry takes gemm_chain_plain, which tests/test_torch_port_tools.py holds
against the JAX probe.
"""

import numpy as np
import pytest
import torch

from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import gemm_chain as gc


@pytest.mark.parametrize("width", range(128, _cuda.CHAIN_MAX_WIDTH + 1, 128))
def test_chain_shape_takes_every_width(width):
    for rows, layers in ((1, 1), (129, 2), (63040, 12)):
        _cuda.chain_shape(rows, width, layers)


@pytest.mark.parametrize("args", [(0, 768, 1), (10, 768, 0), (-1, 256, 2), (10, 0, 1),
                                  (10, 64, 1), (10, 96, 1), (10, 200, 1), (10, 896, 1),
                                  (10, 1024, 1), (10, 768, 2 ** 22)])
def test_chain_geometry_refuses(args):
    """What the kernels do not take is refused on the host, before the
    library is built or asked."""
    with pytest.raises(ValueError):
        _cuda.chain_shape(*args)
    with pytest.raises(ValueError):
        _cuda.chain_geometry(*args)


def _inputs(rows=70, width=128, layers=3):
    rng = np.random.default_rng(16)
    h = torch.from_numpy(rng.normal(size=(rows, width)).astype(np.float32)).bfloat16()
    ws = torch.from_numpy((rng.normal(size=(layers, width, width)) * width ** -0.5)
                          .astype(np.float32)).bfloat16()
    return h, ws


@pytest.mark.parametrize("entry", [gc.gemm_chain_per_layer, gc.gemm_chain_megakernel])
def test_chain_entries_take_the_plain_chain_on_cpu(entry):
    """On CPU tensors both entries are the plain chain, launch nothing, and
    keep bf16; the plain chain rounds once a layer (the f32 chain of the
    same bf16 weights drifts from it by a few bf16 ulps)."""
    h, ws = _inputs()
    _cuda.reset_launches()
    got = entry(h, ws)
    assert _cuda.launches() == {}
    assert got.dtype == torch.bfloat16 and got.shape == h.shape
    assert torch.equal(got, gc.gemm_chain_plain(h, ws))
    f32 = h.float()
    for w in ws:
        f32 = f32 @ w.float()
    err = (got.float() - f32).abs().max() / f32.abs().max()
    assert 0 < err <= 2e-2


def test_chain_kernels_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (the entries route CPU
    tensors to the plain chain before them); any other device is refused."""
    h, ws = _inputs()
    with pytest.raises(ValueError):
        _cuda.gemm_chain(h, ws)
    with pytest.raises(ValueError):
        _cuda.gemm_chain_layer(h, ws[0])
    with pytest.raises(ValueError):
        gc.gemm_chain_megakernel(h.to("meta"), ws.to("meta"))
    with pytest.raises(ValueError):
        gc.gemm_chain_per_layer(h.to("meta"), ws.to("meta"))
