"""The PyTorch port stands alone: no module of dfd_clip_tpu_torch, and not
chip_smoke.py, imports jax, optax or the JAX package; importing the port
(its training engine included) pulls in neither jax, optax nor yaml; its
entry points default to the card and raise without one."""

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


@pytest.mark.parametrize("modules", [
    "dfd_clip_tpu_torch, dfd_clip_tpu_torch.serve, dfd_clip_tpu_torch.config, "
    "dfd_clip_tpu_torch.ops._cuda, dfd_clip_tpu_torch.models.weights",
    "dfd_clip_tpu_torch.engine.trainer, dfd_clip_tpu_torch.engine.optim, "
    "dfd_clip_tpu_torch.ops.decoder_attention_vjp",
], ids=["serve", "train"])
def test_importing_the_port_loads_no_jax_or_yaml(modules):
    code = ("import sys\n"
            f"import {modules}\n"
            "print(sorted(m for m in ('jax', 'optax', 'yaml', 'cv2', 'dfd_clip_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["resolve_device", "Detector", "Trainer"])
def test_default_device_is_the_card(entry):
    """Detector (whose forward and predict run on its device) and Trainer
    default to the card."""
    from dfd_clip_tpu_torch import resolve_device
    from dfd_clip_tpu_torch.engine.trainer import Trainer
    from dfd_clip_tpu_torch.models.detector import Detector

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
        else:
            Trainer(Trainer.get_default_config(), Detector(cfg, num_frames=4, device="cpu"), {})
    assert resolve_device("cpu").type == "cpu"


def test_unported_options_raise():
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0], "out_dim": [2],
                              "op_mode": {"compute_int8": 1}})
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
                                    {"op_mode": {"ema_frame": 0.5}}],
                         ids=["compression", "temporal", "patch_mask", "ema_frame"])
def test_unported_train_modes_raise(option):
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0], "out_dim": [2],
                              "losses": ["auc_roc"], **option})
    det = Detector(cfg, num_frames=4, device="cpu")
    with pytest.raises(NotImplementedError):
        det.forward(None, torch.zeros(1, 4, 3, 32, 32), [None], torch.ones(1, 4, dtype=torch.bool),
                    train=True)
