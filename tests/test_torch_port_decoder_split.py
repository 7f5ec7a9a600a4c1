"""The decoder attention split over chunks of L (dfd_clip_tpu_torch on the
CPU, plain versions) against the JAX package: the port's plain partials of
1, 3 and 7 chunks of L, merged in chunk order by merge_decoder_partials_plain
(the plain version of the fused kernel's second launch, JAX's combine of
dfd_clip_tpu/ops/spmd.py), against JAX's fused_decoder_attention (Pallas,
interpreted) over the whole L, normalised and ``partials``; and the
chunk schedule the wrapper sizes its workspace by (_cuda.decoder_split).

Tolerance: the JAX VJP suite's rtol 2e-4, atol 2e-5, as the existing
partials tests (tests/test_torch_port_train.py): both sides compute in f32
and differ only in summation order and where the maximum is taken.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu.ops.pallas_decoder_attention import fused_decoder_attention as j_fused_dec
from dfd_clip_tpu_torch.models.decoder import token_mask
from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops.decoder_attention import (
    decoder_attention_partials_plain,
    merge_decoder_partials_plain,
)

TOL = dict(rtol=2e-4, atol=2e-5)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def split_inputs(rng, b=3, nsel=2, h=2, d=64, t=5, p=13):
    """Stacked K/V (read at slot 1), pos and a mask over L = 5 x 13 = 65
    tokens: sample 1's last frames masked, the last sample fully masked."""
    l = t * p
    qs, qc = (rng.standard_normal((b, 1, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((nsel, b, l, h, d)).astype(np.float32) for _ in range(2))
    pos = (0.1 * rng.standard_normal((l, h, d))).astype(np.float32)
    frames = np.ones((b, t), bool)
    frames[1, t // 2 + 1:] = False
    frames[-1] = False
    mask = token_mask(torch.from_numpy(frames), p, None).numpy()
    return qs, qc, k, v, pos, mask


@pytest.mark.parametrize("form", ["normalised", "partials"])
@pytest.mark.parametrize("chunks", [1, 3, 7])
def test_merged_chunk_partials_match_jax(rng, chunks, form):
    """Chunks of ceil(L / n) tokens (the last one ragged); with more than
    one chunk, chunk 1 is masked in every sample. The merged state equals
    JAX's partials over the whole L, and its normalised form JAX's output;
    the fully masked sample gives (0, 0, -1e30) and 0."""
    qs, qc, k, v, pos, mask = split_inputs(rng)
    l = mask.shape[1]
    size = -(-l // chunks)
    bounds = [(lo, min(lo + size, l)) for lo in range(0, l, size)]
    assert len(bounds) == chunks
    assert chunks == 1 or bounds[-1][1] - bounds[-1][0] < size
    if chunks > 1:
        mask[:, bounds[1][0]: bounds[1][1]] = False
    tq = [torch.from_numpy(a) for a in (qs, qc)]
    parts = [decoder_attention_partials_plain(
        *tq, torch.from_numpy(k[:, :, lo:hi]), torch.from_numpy(v[:, :, lo:hi]),
        torch.from_numpy(mask[:, lo:hi]), torch.from_numpy(pos[lo:hi]), layer=1)
        for lo, hi in bounds]
    if chunks > 1:   # the masked chunk's own state: nothing, at the finite -1e30
        assert torch.equal(parts[1][1][:, 1], torch.full_like(parts[1][1][:, 1], -1e30))
    jargs = [jnp.asarray(a) for a in (qs, qc, k, v)] + [jnp.asarray(mask)]
    if form == "partials":
        o_sc, st = merge_decoder_partials_plain(parts)
        want_o, want_st = j_fused_dec(*jargs, temporal_pos=jnp.asarray(pos), layer=1,
                                      partials=True)
        close(o_sc, want_o)
        close(st, want_st)
        assert torch.equal(o_sc[2], torch.zeros_like(o_sc[2]))
        assert torch.equal(st[2, 0], torch.zeros_like(st[2, 0]))
        assert torch.equal(st[2, 1], torch.full_like(st[2, 1], -1e30))
    else:
        out = merge_decoder_partials_plain(parts, normalise=True)
        close(out, j_fused_dec(*jargs, temporal_pos=jnp.asarray(pos), layer=1))
        assert out.shape == (3, 1, 2, 64)
        assert torch.equal(out[2], torch.zeros_like(out[2]))


@pytest.mark.parametrize("heads", [12, 16])
@pytest.mark.parametrize("tokens,chunks", [(1, 1), (63, 1), (64, 1), (65, 2), (127, 2),
                                           (129, 3), (4000, 63), (5120, 80), (11520, 180)])
def test_decoder_split_edges(tokens, chunks, heads):
    """The chunk schedule: L below one chunk, at a multiple, one past it, and
    the paths' L (ViT-B 20 x 200, ViT-L 20 x 256, ViT-L@336 20 x 576), with
    12 and 16 heads: a block a (chunk, head)."""
    got = _cuda.decoder_split(tokens, heads)
    assert got == {"chunk": _cuda.DECODER_CHUNK, "chunks": chunks, "blocks": chunks * heads}
    assert (chunks - 1) * got["chunk"] < tokens <= chunks * got["chunk"]


@pytest.mark.parametrize("tokens,heads", [(0, 12), (4000, 0)])
def test_decoder_split_refuses_empty(tokens, heads):
    with pytest.raises(ValueError):
        _cuda.decoder_split(tokens, heads)
