"""The JAX package's five int8 AUROC gates (tests/test_int8_e2e.py:47-250)
on the port, at their tiny size and thresholds (dfd_clip_tpu_torch on the
CPU, plain versions): dfd_clip_tpu_torch.tools.int8_gates trains the JAX
tests' tiny_detector (ViT-Test, f32, 4-frame clips of 2 s, batch 16, lr
3e-3) on the separable and the adversarial fixture trees and scores it in
bf16, compute_int8, compute_int8 + int8_rows and through the whole-encoder
tower with int8 attention "1", and trains one with compute_int8. The fifth
gate, training through the decoder VJP, is the separable gate's training:
every decoder attention call of it goes through the trainable Function.
The trees are tests/test_learning.py's, byte for byte.
"""

import filecmp
from pathlib import Path

import pytest

from dfd_clip_tpu_torch.ops import decoder_attention_vjp
from dfd_clip_tpu_torch.runtime import OneProcess
from dfd_clip_tpu_torch.tools import int8_gates as gates


class Quiet(OneProcess):
    def print(self, *a, **k):
        pass


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """run_gates once on the CPU, counting the trainable Function's calls."""
    calls = []
    fn = decoder_attention_vjp.fused_decoder_attention_trainable

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    decoder_attention_vjp.fused_decoder_attention_trainable = counted
    try:
        out = gates.run_gates(gates.flagship_factory("cpu"), str(tmp_path_factory.mktemp("gates")),
                              Quiet("cpu"), log=lambda *_: None)
    finally:
        decoder_attention_vjp.fused_decoder_attention_trainable = fn
    return out, len(calls)


def test_fixture_trees_are_the_jax_tests(tmp_path):
    """The tool's separable and adversarial trees equal tests/
    test_learning.py's file for file, byte for byte."""
    from test_learning import make_adversarial_ffpp_tree, make_separable_ffpp_tree

    for ours, theirs in ((gates.make_separable_ffpp_tree, make_separable_ffpp_tree),
                         (gates.make_adversarial_ffpp_tree, make_adversarial_ffpp_tree)):
        a, b = (Path(f(str(tmp_path / name / ours.__name__)))
                for f, name in ((ours, "port"), (theirs, "jax")))
        files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
        assert len(files) > 8
        assert all(filecmp.cmp(a / f, b / f, shallow=False) for f in files)


def test_bf16_trained_int8_scored_auroc_holds(readings):
    g = readings[0]["separable"]
    assert all(v > 0.9 for v in g.values()), g
    assert abs(g["bf16"] - g["int8"]) < 0.05 and abs(g["bf16"] - g["int8_rows"]) < 0.05, g


def test_int8_auroc_delta_on_adversarial_fixture(readings):
    g = readings[0]["adversarial"]
    assert 0.72 < g["bf16"] < 0.999, g
    assert g["int8"] >= g["bf16"] - 0.02 and g["int8_rows"] >= g["bf16"] - 0.02, g


def test_bf16_trained_megakernel_int8_attn_scored_auroc_holds(readings):
    g = readings[0]["tower"]
    assert g["bf16"] > 0.9 and g["tower_int8_attn"] > 0.9, g
    assert abs(g["bf16"] - g["tower_int8_attn"]) < 0.05, g


def test_int8_trained_auroc_holds(readings):
    g = readings[0]["int8_trained"]
    assert g["int8"] > 0.9 and g["bf16"] > 0.9, g
    assert abs(g["int8"] - g["bf16"]) < 0.05, g


def test_train_through_decoder_vjp_learns(readings):
    """The separable gate's bf16 training ran every decoder attention call
    through the trainable Function (2 blocks a task batch, 30 + 60 + 30 +
    30 steps), and the model learned (AUROC > 0.9); no gate failed."""
    out, calls = readings
    assert calls == 2 * (30 + 60 + 30 + 30)
    assert out["separable"]["bf16"] > 0.9
    assert out["failures"] == []
