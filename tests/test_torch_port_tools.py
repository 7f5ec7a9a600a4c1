"""The port of the tools/ study kernels on the CPU against the JAX tools: each
numerics mode of ops/study_attention.py against the matching
tools/bench_attention.py variant (its Pallas kernel interpreted, N shrunk
to 4 frames), and the megakernel probe's chain (ops/gemm_chain.py) against
tools/bench_megakernel_probe.py's per_layer_calls and megakernel (3 layers,
512 rows, interpreted); the port's tool entry points with --device cpu.
Inputs come from numpy with fixed seeds and are rounded to bf16 once, so
both sides read the same values.

Tolerance, with its reason: every output here is bf16, so the holds are
1e-2 of the output's maximum (two bf16 ulps): an f32 sum taken in another
order, or an exp of another implementation, can move a value across a
rounding step, and the chained products carry such a step into the next
layer (observed 3.1e-3 after three layers).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfd_clip_tpu_torch.ops import _cuda
from dfd_clip_tpu_torch.ops import gemm_chain as gc
from dfd_clip_tpu_torch.ops import study_attention as sa
from dfd_clip_tpu_torch.tools import bench_attention as tba
from dfd_clip_tpu_torch.tools import bench_decoder_boundary as tbd
from dfd_clip_tpu_torch.tools import bench_megakernel_probe as tbm

ROOT = Path(__file__).resolve().parent.parent
REL_BF16 = 1e-2


def _load_tool(name):
    """tools/<name>.py of the JAX package, imported by path (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_attention():
    return _load_tool("bench_attention")


@pytest.fixture(scope="module")
def megakernel_probe():
    return _load_tool("bench_megakernel_probe")


def rel_err(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


# one variant of each kernel body (pallas_frames8 needs N >= 8)
STUDY_VARIANTS = {
    "pallas_frames2": "f32", "pallas_batched_dot": "f32", "pallas_pair_packed": "f32",
    "pallas_pad256": "f32", "pallas_bf16_f1": "bf16", "pallas_full_packed": "bf16",
    "pallas_diet_max_f1": "diet", "pallas_diet_nomax_f1": "diet_nomax",
}


@pytest.fixture(scope="module")
def study_inputs():
    """4 frames of (197, 12, 64), normal, rounded to bf16 (f32 arrays of
    bf16 values)."""
    rng = np.random.default_rng(31)
    return [np.asarray(torch.from_numpy(rng.normal(size=(4, 197, 12, 64)).astype(np.float32))
                       .bfloat16().float()) for _ in range(3)]


@pytest.mark.parametrize("variant", list(STUDY_VARIANTS))
def test_study_mode_matches_its_pallas_variant(bench_attention, monkeypatch, study_inputs,
                                               variant):
    monkeypatch.setattr(bench_attention, "N", 4)
    mode = STUDY_VARIANTS[variant]
    assert tba.VARIANTS[variant].__name__ == f"study_{mode}"
    q, k, v = study_inputs
    want = bench_attention.VARIANTS[variant](*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    _cuda.reset_launches()
    got = sa.study_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), mode)
    assert _cuda.launches() == {}     # a CPU tensor runs the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, 197, 12, 64)
    assert rel_err(got, want) <= REL_BF16


@pytest.mark.parametrize("variant", ["xla_einsum", "pallas_current"])
def test_tool_reference_variants_match(bench_attention, monkeypatch, study_inputs, variant):
    """The port's xla_einsum (plain_attention) and pallas_current (the
    encoder attention, plain on the CPU) against the JAX tool's."""
    monkeypatch.setattr(bench_attention, "N", 4)
    q, k, v = study_inputs
    want = bench_attention.VARIANTS[variant](*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = tba.VARIANTS[variant](*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert rel_err(got, want) <= REL_BF16


def test_study_modes_differ_where_their_rounding_does(study_inputs):
    """The four modes are four functions: each pair differs somewhere (the
    modes are not aliases of one another), by less than 2 bf16 ulps."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in study_inputs)
    outs = {m: sa.study_attention_plain(q, k, v, m).float() for m in sa.MODES}
    for a in sa.MODES:
        for b in sa.MODES:
            if a < b:
                d = (outs[a] - outs[b]).abs().max() / outs[a].abs().max()
                assert 0 < d <= REL_BF16, (a, b, d)
    with pytest.raises(ValueError):
        sa.study_attention_plain(q, k, v, "tf32")


@pytest.fixture(scope="module")
def chain_inputs():
    rng = np.random.default_rng(32)
    ws = [np.asarray(torch.from_numpy((rng.normal(size=(768, 768)) * 0.02).astype(np.float32))
                     .bfloat16().float()) for _ in range(3)]
    h = np.asarray(torch.from_numpy((rng.normal(size=(512, 768)) * 0.02).astype(np.float32))
                   .bfloat16().float())
    return h, ws


@pytest.mark.parametrize("entry", ["per_layer_calls", "megakernel"])
def test_gemm_chain_matches_the_probe(megakernel_probe, monkeypatch, chain_inputs, entry):
    monkeypatch.setattr(megakernel_probe, "LAYERS", 3)
    h, ws = chain_inputs
    want = getattr(megakernel_probe, entry)(jnp.asarray(h, jnp.bfloat16),
                                            [jnp.asarray(w, jnp.bfloat16) for w in ws], 256)
    wst = torch.stack([torch.from_numpy(w) for w in ws]).bfloat16()
    port = {"per_layer_calls": gc.gemm_chain_per_layer, "megakernel": gc.gemm_chain_megakernel}
    _cuda.reset_launches()
    got = port[entry](torch.from_numpy(h).bfloat16(), wst)
    assert _cuda.launches() == {}
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gc.gemm_chain_plain(torch.from_numpy(h).bfloat16(), wst))
    assert rel_err(got, want) <= REL_BF16


def test_tool_entry_points_check_on_cpu(monkeypatch, capsys):
    """Both tools' main() with --device cpu: the tool's correctness checks on
    shrunk shapes, and no timing."""
    monkeypatch.setattr(tba, "N", 4)
    assert tba.main(["--device", "cpu", "xla_einsum", "pallas_current", "pallas_bf16_f1",
                     "pallas_diet_nomax_f2", "pallas_pad256"]) == 0
    out = capsys.readouterr().out
    assert "not timed" in out and "pallas_pad256" in out
    monkeypatch.setattr(tbm, "ROWS", 64)
    monkeypatch.setattr(tbm, "CHECK_ROWS", 64)
    monkeypatch.setattr(tbm, "LAYERS", 2)
    assert tbm.main(["--device", "cpu"]) == 0
    assert "correctness ok, max err 0.0" in capsys.readouterr().out


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tba.main(["xla_einsum"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbm.main(["--check"])


def test_boundary_tool_checks_on_cpu_and_defaults_to_the_card(capsys):
    """bench_decoder_boundary's main(): with --device cpu its check at a
    narrow width and no timing; without a device argument the card, which
    this machine lacks."""
    assert tbd.main(["--device", "cpu", "--widths", "64"]) == 0
    out = capsys.readouterr().out
    assert "width 64: correctness ok" in out and " ms" not in out
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbd.main(["--widths", "64"])
