"""The kernels on a multi-rank layout (counterpart of dfd_clip_tpu/ops/spmd.py).

JAX runs its Pallas kernels per device inside ``shard_map`` over the
runtime's (data, seq) mesh. Here each rank is already its own program: it
holds its clips (its data index's rows) and, when the seq width is above
1, its frames of them (its seq index's share), and runs the same kernels
on those. Two wrappers:

* ``spmd_encoder_kv``: the frozen tower over the rank's (b/dp, t/sp)
  clips x frames, with no collective: the encoder is embarrassingly
  parallel over (batch x frames).
* ``spmd_decoder_attention``: the decoder's single-query dual attention
  over the token-sharded K/V stream. The rank runs the fused kernel's
  ``partials`` form on its tokens (un-normalised numerator, denominator
  and running maximum, and the CoDA sum), and the seq row combines them
  exactly, the one-query case of ring attention (spmd.py:150-166): the
  maximum over the row, each rank's state rescaled by exp(m_loc - gmax),
  numerator, denominator and CoDA summed. Two collectives a call: one MAX
  of the (B, H) maxima, one SUM of the packed (numerator, denominator,
  CoDA) buffer. The temporal embedding comes whole (L, H, D), and the
  rank reads its rows of it.

``data_reduce`` is a MAX or SUM over the data ranks outside autograd
(Sinkhorn-Knopp's normalisations), ``data_sum`` the differentiable SUM
that global-batch statistics (the 768-bn adapter's, CompInv's loss maps)
are built from, and ``data_gather`` the differentiable all-gather of the
data ranks' rows (KoLeo's nearest neighbours over the global batch, and
SSL's FSDP leaves).

The layout is the registered ``runtime.MeshRuntime`` (``spmd_layout``):
None on one rank, so a one-process run never reaches these paths. The
trainable form is ops/decoder_attention_vjp.py's
``spmd_decoder_attention_trainable``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .fused_decoder_attention import fused_decoder_attention


def spmd_layout():
    """The registered runtime when it has more than one rank, else None."""
    from ..runtime import mesh as mesh_rt

    layout = mesh_rt.current_mesh()
    return layout if layout is not None and layout.num_processes > 1 else None


def data_rows(b_local: int):
    """(global rows, this rank's slice of them) when a batch of ``b_local``
    rows is a data rank's share on the registered layout (data width above
    1), else None: what a draw over the global batch keeps on this rank
    (models/layers.py:dropout)."""
    layout = spmd_layout()
    if layout is None or layout.data_parallel == 1:
        return None
    n = b_local * layout.data_parallel
    return n, layout.rows(n)


def data_reduce(t: torch.Tensor, op: str, layout) -> torch.Tensor:
    """``t`` reduced with ``op`` ("sum" or "max") over the data ranks of
    ``layout``, a copy outside autograd; ``t`` itself without a layout or
    at one data rank."""
    if layout is None or layout.data_parallel == 1:
        return t
    return layout.all_reduce_(t.detach().contiguous().clone(), op, "data")


class _DataSum(torch.autograd.Function):
    """Forward: the tensor summed over the data ranks; backward: its
    cotangent summed over them, so that each rank's gradient through its
    own rows is that of the ranks' summed loss."""

    @staticmethod
    def forward(ctx, t, layout):
        ctx.layout = layout
        return data_reduce(t, "sum", layout)

    @staticmethod
    def backward(ctx, ct):
        return data_reduce(ct, "sum", ctx.layout), None


def data_sum(t: torch.Tensor, layout=None) -> torch.Tensor:
    """``t`` summed over the data ranks of ``layout`` (default the
    registered one), differentiable: a statistic of the global batch built
    from each rank's partial sums. The backward sums the cotangent over the
    data ranks, the scaling under which the trainers' mean of the ranks'
    gradients is the gradient of the global batch's loss: a loss that is a
    rank's mean over its rows sums to dp times the global mean, and a loss
    that is itself global (the same on every rank) gets dp times its
    gradient, the trainers' division by the world undoing both. One data
    rank: ``t`` itself."""
    layout = layout if layout is not None else spmd_layout()
    if layout is None or layout.data_parallel == 1:
        return t
    return _DataSum.apply(t, layout)


class _DataGather(torch.autograd.Function):
    """Forward: the data ranks' tensors concatenated along the leading axis
    in rank order; backward: the cotangent summed over the data ranks, this
    rank's rows of it (an all-reduce, then the slice: Gloo has no
    reduce-scatter to lean on)."""

    @staticmethod
    def forward(ctx, t, layout):
        ctx.layout = layout
        return torch.cat(layout.all_gather(t.detach().contiguous(), "data"))

    @staticmethod
    def backward(ctx, ct):
        lay = ctx.layout
        ct = lay.all_reduce_(ct.contiguous().clone(), "sum", "data")
        return ct[lay.rows(ct.shape[0])].clone(), None   # not a view: the whole is freed


def data_gather(t: torch.Tensor, layout=None) -> torch.Tensor:
    """The data ranks' ``t`` (each rank's rows of a global batch, or its
    slice of a leaf) whole, differentiably: a rank's gradient through
    another rank's rows reaches that rank, so each rank's gradient is that
    of the ranks' summed loss, the scaling ``data_sum`` describes. One data
    rank: ``t`` itself."""
    layout = layout if layout is not None else spmd_layout()
    if layout is None or layout.data_parallel == 1:
        return t
    return _DataGather.apply(t, layout)


def encoder_shapes_ok(b: int, t: int, layout) -> bool:
    """A global batch of ``b`` clips of ``t`` frames splits over the layout."""
    return b % layout.data_parallel == 0 and t % layout.seq_parallel == 0


def seq_layout(t_local: int, num_frames: int):
    """The registered multi-rank layout when a clip's ``t_local`` frames on
    this rank are its seq share of ``num_frames`` (seq width above 1), else
    None: the rank then holds whole clips and runs the one-rank path."""
    layout = spmd_layout()
    if layout is None or layout.seq_parallel == 1:
        return None
    return layout if t_local * layout.seq_parallel == num_frames else None


def decoder_shapes_ok(l_local: int, temporal_pos: Optional[torch.Tensor], layout) -> bool:
    """A call shows that it carries this rank's token shard when the seq
    width is above 1 and its whole temporal embedding spans the seq row's
    tokens. A call without one cannot show it, and stays on the one-rank
    path (a caller that knows, such as the decoder, calls the sharded forms
    itself); so does every call at seq width 1, where a rank holds whole
    clips."""
    return layout.seq_parallel > 1 and temporal_pos is not None \
        and temporal_pos.shape[0] == l_local * layout.seq_parallel


def spmd_encoder_kv(tower: Callable, enc_params: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``tower`` ((N, 3, H, W) frames -> {name: (Lsel, N, ...)}) over this
    rank's clips x frames x (b, t, 3, H, W): {name: (Lsel, b, t, ...)}."""
    b, t = x.shape[:2]
    kvs = tower(enc_params, x.reshape((b * t,) + tuple(x.shape[2:])))
    return {s: f.reshape((f.shape[0], b, t) + tuple(f.shape[2:])) for s, f in kvs.items()}


def local_pos(temporal_pos: Optional[torch.Tensor], l_local: int, layout):
    """This rank's rows of the whole (L, H, D) temporal embedding."""
    if temporal_pos is None:
        return None
    if temporal_pos.shape[0] != l_local * layout.seq_parallel:
        raise ValueError(f"temporal_pos has {temporal_pos.shape[0]} rows for {l_local} local "
                         f"tokens on {layout.seq_parallel} seq ranks")
    s = layout.seq_index
    return temporal_pos[s * l_local:(s + 1) * l_local]


def combine_partials(o_sc: torch.Tensor, st: torch.Tensor, layout):
    """The seq row's exact combine of each rank's partials (o_sc (B, 2, H*D),
    st (B, 2, H), as the fused kernel writes them) -> (o_s, o_c, den, gmax):
    the normalised softmax output and the CoDA output (B, H, D) f32, and the
    combined denominator and maximum (B, H) f32, equal on every rank of the
    row. A fully masked sample gives o_s 0."""
    b, h = st.shape[0], st.shape[2]
    d_loc, m_loc = st[:, 0], st[:, 1]
    gmax = layout.all_reduce_(m_loc.clone(), "max", "seq")
    r = torch.exp(m_loc - gmax)                                   # a shard's rescale, <= 1
    packed = torch.cat([(o_sc[:, 0].reshape(b, h, -1) * r[..., None]).reshape(b, -1),
                        o_sc[:, 1], d_loc * r], dim=1)
    layout.all_reduce_(packed, "sum", "seq")
    hd = o_sc.shape[2]
    num = packed[:, :hd].reshape(b, h, -1)
    o_c = packed[:, hd:2 * hd].reshape(b, h, -1)
    den = packed[:, 2 * hd:]
    o_s = num / den.clamp_min(1e-30)[..., None]                   # fully masked -> 0
    return o_s, o_c, den, gmax


def spmd_decoder_attention(
    q_smax: torch.Tensor, q_coda: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, temporal_pos: Optional[torch.Tensor], layer: Optional[int], layout,
    return_stats: bool = False, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """Token-sharded fused decoder attention with the exact combine.

    q_*: (B, 1, H, D) this rank's queries; k/v: its tokens, (B, l, H, D) or
    the stacked (Lsel, B, l, H, D) read at ``layer``; mask (B, l);
    temporal_pos: the whole (l * seq, H, D) embedding or None. Returns the
    (B, 1, H, D) output (in V's dtype; the queries' for int8 K/V), equal on every
    rank of the seq row. ``return_stats`` also returns the combined
    denominator and maximum (B, H) and the normalised softmax output
    (B, H, D), all f32, for the trainable form's backward.
    ``k_scale``/``v_scale``: int8_rows row scales, sharded like K/V."""
    l_loc = (k[layer] if layer is not None else k).shape[1]
    pos = local_pos(temporal_pos, l_loc, layout)
    o_sc, st = fused_decoder_attention(q_smax, q_coda, k, v, mask, pos, layer, partials=True,
                                       k_scale=k_scale, v_scale=v_scale)
    o_s, o_c, den, gmax = combine_partials(o_sc, st, layout)
    cd = q_smax.dtype if v.dtype == torch.int8 else v.dtype   # as the one-rank int8 form
    out = (0.5 * (o_s + o_c)).to(cd)[:, None]
    if return_stats:
        return out, den, gmax, o_s
    return out
