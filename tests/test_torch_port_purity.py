"""The PyTorch port stands alone: no module of dfd_clip_tpu_torch, and not
chip_smoke.py, imports jax, optax or the JAX package, or reads the
environment (the JAX package's kernel switches are explicit arguments
here); importing the port (its training engine, both towers, the
whole-encoder tower, the serving and evaluation entries and the data side
included) pulls in neither jax, optax, yaml nor cv2; its entry points
default to the card and raise without one; the options it has not ported
raise."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dfd_clip_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "dfd_clip_tpu"), f"{path.name} imports {mod}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_environment(path):
    """No os.environ / os.getenv / os.putenv: a kernel path is chosen by an
    argument (EncoderKernels, clip_vision_kv's block / tower / int8_attn),
    never by a process-wide switch."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("environ", "getenv", "putenv", "environb"), \
                f"{path.name}:{node.lineno} reads the environment"
    assert "getenv" not in path.read_text()


@pytest.mark.parametrize("modules", [
    "dfd_clip_tpu_torch, dfd_clip_tpu_torch.serve, dfd_clip_tpu_torch.config, "
    "dfd_clip_tpu_torch.ops._cuda, dfd_clip_tpu_torch.models.weights, "
    "dfd_clip_tpu_torch.ops.int8",
    "dfd_clip_tpu_torch.engine.trainer, dfd_clip_tpu_torch.engine.optim, "
    "dfd_clip_tpu_torch.ops.decoder_attention_vjp",
    "dfd_clip_tpu_torch.models.dinov2_vit, dfd_clip_tpu_torch.ops.attention, "
    "dfd_clip_tpu_torch.ops.encoder_block, dfd_clip_tpu_torch.models.detector, "
    "dfd_clip_tpu_torch.ops.tower",
    "dfd_clip_tpu_torch.ops.study_attention, dfd_clip_tpu_torch.ops.gemm_chain, "
    "dfd_clip_tpu_torch.tools.bench_attention, dfd_clip_tpu_torch.tools.bench_megakernel_probe, "
    "dfd_clip_tpu_torch.tools.bench_tower_stages",
    "dfd_clip_tpu_torch.inference, dfd_clip_tpu_torch.data, dfd_clip_tpu_torch.data.video, "
    "dfd_clip_tpu_torch.data.loader, dfd_clip_tpu_torch.data.datasets, "
    "dfd_clip_tpu_torch.utils.metrics, dfd_clip_tpu_torch.scoring, "
    "dfd_clip_tpu_torch.ops.image_ops, dfd_clip_tpu_torch.device, dfd_clip_tpu_torch.runtime",
], ids=["serve", "train", "towers", "tools", "eval"])
def test_importing_the_port_loads_no_jax_or_yaml(modules):
    code = ("import sys\n"
            f"import {modules}\n"
            "print(sorted(m for m in ('jax', 'optax', 'yaml', 'cv2', 'dfd_clip_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["resolve_device", "Detector", "Trainer",
                                   "Scorer.from_preset", "inference.main"])
def test_default_device_is_the_card(entry):
    """Detector (whose forward and predict run on its device), Trainer, the
    run-directory Scorer and the evaluation CLI default to the card."""
    from dfd_clip_tpu_torch import inference, resolve_device
    from dfd_clip_tpu_torch.config import CN
    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.models.detector import Detector
    from dfd_clip_tpu_torch.serve import Scorer

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0],
                              "out_dim": [2], "losses": ["auc_roc"]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "resolve_device":
            resolve_device()
        elif entry == "Detector":
            Detector(cfg, num_frames=4)
        elif entry == "Scorer.from_preset":
            Scorer.from_preset(CN({"model": cfg.to_dict(),
                                   "data": {"num_frames": 4, "clip_duration": 1.0}}),
                               "/nonexistent")
        elif entry == "inference.main":
            inference.main(inference.parse_args(["/nonexistent"]))
        else:
            Trainer(Trainer.get_default_config(), Detector(cfg, num_frames=4, device="cpu"), {})
    assert resolve_device("cpu").type == "cpu"


def test_unported_options_raise():
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0], "out_dim": [2],
                              "op_mode": {"kv_dtype": "int8"}})
    with pytest.raises(NotImplementedError):
        Detector(cfg, num_frames=4, device="cpu")
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0], "out_dim": [2],
                              "adapter": {"type": "normal"}})
    with pytest.raises(NotImplementedError):
        Detector(cfg, num_frames=4, device="cpu")


@pytest.mark.parametrize("option", [{"train_mode": {"compression": "sync"}},
                                    {"train_mode": {"temporal": "ranking"}},
                                    {"train_mode": {"patch_mask": {"type": "batch"}}},
                                    {"op_mode": {"ema_frame": 0.5}},
                                    {"op_mode": {"compute_int8": 1}},
                                    {"op_mode": {"kv_dtype": "int8_rows"}}],
                         ids=["compression", "temporal", "patch_mask", "ema_frame",
                              "compute_int8", "int8_rows"])
def test_unported_train_modes_raise(option):
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0], "out_dim": [2],
                              "losses": ["auc_roc"], **option})
    det = Detector(cfg, num_frames=4, device="cpu")
    with pytest.raises(NotImplementedError):
        det.forward(None, torch.zeros(1, 4, 3, 32, 32), [None], torch.ones(1, 4, dtype=torch.bool),
                    train=True)


@pytest.mark.parametrize("option", ["swiglu_ffn", "int8_wider_than_1024", "foundation"])
def test_unported_tower_options_raise(option):
    """giant2's fused SwiGLU FFN, W8A8 towers wider than 1024 (JAX's XLA
    linear_w8a8 composition) and unknown foundations raise."""
    from dfd_clip_tpu_torch.models import clip_vit, dinov2_vit
    from dfd_clip_tpu_torch.models.detector import Detector

    with pytest.raises(NotImplementedError):
        if option == "swiglu_ffn":
            dinov2_vit.init_dinov2(torch.Generator(), dinov2_vit.ARCHITECTURES["ViT-g/14"])
        elif option == "int8_wider_than_1024":
            cfg = clip_vit.ViTConfig(input_resolution=32, width=1280, heads=16)
            clip_vit.clip_vision_kv({}, torch.zeros(1, 3, 32, 32), cfg, compute_int8=True)
        else:
            cfg = Detector.get_default_config()
            cfg.merge_from_other_cfg({"foundation": "resnet", "decode_mode": "index",
                                      "decode_indices": [0], "out_dim": [2]})
            Detector(cfg, num_frames=4, device="cpu")
