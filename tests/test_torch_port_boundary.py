"""The launch geometry of the port's two row-level kernels, checked on the
CPU: the decoder boundary's one cooperative launch
(_cuda.boundary_geometry, csrc/decoder_boundary.cu) and layer_norm_rows's
row template (_cuda.ln_chunks, csrc/layer_norm.cu).

The boundary deals each stage's output columns to its blocks in units of 8
and keeps every block's weight slices, its LayerNorm tile and its partial
sums in shared memory at once: at the decoder widths (64 and 256 in the
tests' configurations, 768 and 1024 on the models) on an H100's 132 SMs,
every column of every stage goes to exactly one block, and no block asks
for more shared memory than it may have. At width 1536 (DINOv2 ViT-g/14's
decoder) the slices do not fit, and the streamed form passes each block's
weights through a ring of K-chunks instead. The kernels themselves run on
the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import pytest

from dfd_clip_tpu_torch.ops import _cuda

H100_SMS = 132


@pytest.mark.parametrize("width", [64, 256, 768, 1024, 1536])
def test_boundary_geometry_covers_every_column_once(width):
    geo = _cuda.boundary_geometry(width, 4 * width, 16, H100_SMS)
    assert geo["grid"] <= H100_SMS and geo["tiles"] == 1
    assert geo["form"] == ("streamed" if width > 1024 else "resident")
    shapes = {"out_proj": (width, width), "c_fc": (width, 4 * width),
              "c_proj": (4 * width, width), "in_proj": (width, 2 * width)}
    assert [s["name"] for s in geo["stages"]] == list(shapes)
    for s in geo["stages"]:
        assert (s["k"], s["n"]) == shapes[s["name"]]
        assert len(s["slices"]) == geo["grid"]
        cols = [c for u0, cnt in s["slices"]
                for c in range(u0 * _cuda.BOUNDARY_UNIT, (u0 + cnt) * _cuda.BOUNDARY_UNIT)]
        assert sorted(cols) == list(range(s["n"])), s["name"]
        assert max(cnt for _, cnt in s["slices"]) == s["max_units"] <= _cuda.BOUNDARY_MAX_UNITS


@pytest.mark.parametrize("width", [64, 256, 768, 1024])
def test_boundary_geometry_fits_shared_memory(width):
    geo = _cuda.boundary_geometry(width, 4 * width, 16, H100_SMS)
    assert geo["smem"] <= _cuda.SMEM_LIMIT == 232448
    # the stages' slices do not overlap, the tile lies above them, and every
    # slice (a bulk copy's destination) and row of the tile is 16-byte aligned
    end = _cuda.BOUNDARY_BARS
    for s in geo["stages"]:
        assert s["w_off"] == end and s["w_off"] % 16 == 0
        end += s["max_units"] * s["k"] * 2 * _cuda.BOUNDARY_UNIT
    assert geo["ln_off"] == end
    assert geo["a_off"] >= end + 16 * width and geo["a_off"] % 128 == 0
    tile = _cuda.BOUNDARY_TILE * (width + _cuda.BOUNDARY_PAD) * 2
    assert geo["smem"] >= _cuda.BOUNDARY_ALIGN + geo["a_off"] + tile


@pytest.mark.parametrize("width,hidden", [(1536, 6144), (1280, 5120), (1536, 4096)])
def test_boundary_geometry_streams_what_does_not_fit(width, hidden):
    """Above width 1024 each block's slices of the four stages would take
    more than a block's shared memory (541,952 bytes at 1536, against
    232,448): the streamed form's ring of K-chunks takes their place. Each
    slot holds a chunk of the block's widest stage (its units' weight rows,
    KC values each, 64 bytes apart to keep the quarter-warp's loads on
    distinct banks); the chunk divides both K, and the warps split it in
    K-steps of 32; the LayerNorms' parameters and the tile lie above the
    ring, inside the block's shared memory."""
    geo = _cuda.boundary_geometry(width, hidden, 16, H100_SMS)
    resident = sum(s["max_units"] * s["k"] * 2 * _cuda.BOUNDARY_UNIT for s in geo["stages"])
    assert resident + _cuda.BOUNDARY_BARS > _cuda.SMEM_LIMIT
    assert geo["form"] == "streamed" and all(s["w_off"] is None for s in geo["stages"])
    kc, slots = geo["kc"], geo["slots"]
    assert width % kc == hidden % kc == 0 and kc % (_cuda.BOUNDARY_KSTEP * 8) == 0
    assert 2 <= slots <= 4 and geo["pitch"] == 2 * kc + 64 and geo["pitch"] % 128 == 64
    most = max(s["max_units"] for s in geo["stages"])
    assert geo["slot_bytes"] == most * _cuda.BOUNDARY_UNIT * geo["pitch"]
    assert geo["ring_off"] == _cuda.BOUNDARY_BARS and geo["ring_off"] % 16 == 0
    assert geo["ln_off"] == geo["ring_off"] + slots * geo["slot_bytes"]
    assert geo["a_off"] >= geo["ln_off"] + 16 * width and geo["a_off"] % 128 == 0
    tile = _cuda.BOUNDARY_TILE * (width + _cuda.BOUNDARY_PAD) * 2
    assert _cuda.BOUNDARY_ALIGN + geo["a_off"] + tile <= geo["smem"] <= _cuda.SMEM_LIMIT
    if (width, hidden) == (1536, 6144):   # the resident layout's bytes, then the ring's
        ln_end = _cuda.BOUNDARY_BARS + resident + 16 * width
        assert _cuda.BOUNDARY_ALIGN + -(-ln_end // 128) * 128 + tile == 541952
        assert (kc, slots, geo["smem"]) == (512, 3, 231680)


@pytest.mark.parametrize("rows,tiles", [(1, 1), (12, 1), (16, 1), (17, 2), (100, 7)])
def test_boundary_geometry_tiles_rows(rows, tiles):
    assert _cuda.boundary_geometry(768, 3072, rows, H100_SMS)["tiles"] == tiles


@pytest.mark.parametrize("width,hidden", [(2048, 8192), (1056, 4224), (80, 320), (768, 3000),
                                          (16, 64)])
def test_boundary_geometry_refuses_widths_no_layout_fits(width, hidden):
    with pytest.raises(ValueError, match="decoder_boundary"):
        _cuda.boundary_geometry(width, hidden, 16, H100_SMS)


def test_boundary_geometry_refuses_too_few_blocks():
    # 1024 wide on 80 SMs: c_fc's 512 units would put 7 on a block
    with pytest.raises(ValueError, match="units"):
        _cuda.boundary_geometry(1024, 4096, 16, 80)


@pytest.mark.parametrize("width,chunks", [(32, 1), (64, 1), (384, 2), (768, 3), (1024, 4),
                                          (1536, 6), (2048, 8)])
def test_layer_norm_rows_chunk_template(width, chunks):
    assert _cuda.ln_chunks(width) == chunks


@pytest.mark.parametrize("width", [2056, 100, 4, 0])
def test_layer_norm_rows_refuses_widths(width):
    with pytest.raises(ValueError, match="layer_norm_rows"):
        _cuda.ln_chunks(width)


def test_decoder_boundary_takes_the_card_or_its_plain_version():
    """On a CPU tensor decoder_boundary takes its plain version only because
    the tensor lies on the CPU; the kernel's wrapper refuses a CPU tensor and
    the entry any other device, instead of falling back."""
    import torch

    from dfd_clip_tpu_torch.ops import decoder_stack as ds
    from dfd_clip_tpu_torch.tools.bench_decoder_boundary import boundary_inputs

    x, o, tail, query = boundary_inputs(64, torch.device("cpu"))
    got = ds.decoder_boundary(x, o, tail, query)
    want = ds.decoder_boundary_plain(x, o, tail, query)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="on the card"):
        _cuda.decoder_boundary(x, o, tail, query)
    with pytest.raises(ValueError, match="unsupported device"):
        ds.decoder_boundary(torch.empty(16, 64, device="meta"), None, None, query)
    _cuda.reset_launches()
    assert _cuda.launches() == {}
