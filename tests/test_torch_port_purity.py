"""The PyTorch port stands alone: no module of dfd_clip_tpu_torch, and not
chip_smoke.py, imports jax, optax or the JAX package, or reads the
environment; the native decoder's C++ sources are the port's own copies,
which include nothing of the JAX package's csrc/ (the JAX package's kernel switches are explicit arguments
here); importing the port (its training engine, both towers, the
whole-encoder tower, the serving and evaluation entries and the data side
included) pulls in neither jax, optax, yaml nor cv2; its entry points
default to the card and raise without one; the options it has not ported
raise, and those ported since build and run."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
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


CPP_FILES = sorted((ROOT / "dfd_clip_tpu_torch" / "csrc").glob("*.cpp"))


@pytest.mark.parametrize("path", CPP_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_cpp_sources_stand_alone(path):
    """The native decoder's C++ sources (the port's own copies) include
    system headers (FFmpeg's, the C++ library's) and nothing by a quoted
    path: nothing of the JAX package's csrc/."""
    includes = [line.split("#include", 1)[1].strip() for line in path.read_text().splitlines()
                if line.lstrip().startswith("#include")]
    assert includes and all(i.startswith("<") and i.endswith(">") for i in includes), includes


def test_native_decoder_builds_from_the_port():
    """data/native_video.py compiles the port's csrc/ copies, into the
    port's build directory, and names no other source."""
    from dfd_clip_tpu_torch.data import native_video

    port = ROOT / "dfd_clip_tpu_torch"
    assert native_video.CSRC == port / "csrc"
    assert sorted(port / "csrc" / s for s in native_video.SOURCES) == CPP_FILES
    assert native_video.BUILD_DIR == ROOT / "build" / "dfd_clip_tpu_torch"
    assert "csrc/build.py" not in (port / "data" / "native_video.py").read_text()


# what a launcher (torchrun, SLURM) hands its ranks: runtime/launch.py's input
LAUNCH = ROOT / "dfd_clip_tpu_torch" / "runtime" / "launch.py"
LAUNCHER_VARS = {"RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "SLURM_PROCID", "SLURM_NTASKS", "SLURM_JOB_NODELIST", "SLURM_LOCALID"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_environment(path):
    """No os.environ / os.getenv / os.putenv: a kernel path is chosen by an
    argument (EncoderKernels, clip_vision_kv's block / tower / int8_attn),
    never by a process-wide switch. The one reader is runtime/launch.py,
    whose input is the launcher's environment: it reads os.environ, only
    the launcher's variables, and writes nothing there."""
    if path == LAUNCH:
        tree = ast.parse(path.read_text(), filename=str(path))
        names = {n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and n.value.isupper() and n.value.replace("_", "").isalpha()}
        assert names and names <= LAUNCHER_VARS, names - LAUNCHER_VARS
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("getenv", "putenv", "environb"), node.lineno
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    assert not (isinstance(t, ast.Subscript) and "environ" in ast.dump(t)), \
                        f"launch.py:{node.lineno} writes the environment"
        return
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("environ", "getenv", "putenv", "environb"), \
                f"{path.name}:{node.lineno} reads the environment"
    assert "getenv" not in path.read_text()


FIRST_IMPORTS = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for sub in ("ops", "models") for p in (ROOT / "dfd_clip_tpu_torch" / sub).glob("*.py"))


@pytest.mark.parametrize("module", FIRST_IMPORTS)
def test_module_imports_first_in_a_fresh_interpreter(module):
    """Each module of ops/ and models/ imports as the first module of a fresh
    interpreter: no import cycle among them (ops/encoder_block.py reads
    models/layers.py, whose package resolves the Detector only on use)."""
    out = subprocess.run([sys.executable, "-c", f"import {module}"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


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
    "dfd_clip_tpu_torch.tools.bench_tower_stages, dfd_clip_tpu_torch.tools.analysis",
    "dfd_clip_tpu_torch.data.tokenizer, dfd_clip_tpu_torch.models.clip_text, "
    "dfd_clip_tpu_torch.models.clip_resnet",
    "dfd_clip_tpu_torch.inference, dfd_clip_tpu_torch.data, dfd_clip_tpu_torch.data.video, "
    "dfd_clip_tpu_torch.data.loader, dfd_clip_tpu_torch.data.datasets, "
    "dfd_clip_tpu_torch.utils.metrics, dfd_clip_tpu_torch.scoring, "
    "dfd_clip_tpu_torch.ops.image_ops, dfd_clip_tpu_torch.device, dfd_clip_tpu_torch.runtime",
    "dfd_clip_tpu_torch.main, dfd_clip_tpu_torch.engine.evaluator, "
    "dfd_clip_tpu_torch.engine.checkpoint, dfd_clip_tpu_torch.engine.callbacks, "
    "dfd_clip_tpu_torch.models.adapter, dfd_clip_tpu_torch.data.augment, "
    "dfd_clip_tpu_torch.engine, dfd_clip_tpu_torch.models, "
    "dfd_clip_tpu_torch.utils.logging, dfd_clip_tpu_torch.utils.tracking, "
    "dfd_clip_tpu_torch.utils.notify",
    "dfd_clip_tpu_torch.ssl, dfd_clip_tpu_torch.ssl.train, dfd_clip_tpu_torch.ssl.meta_arch, "
    "dfd_clip_tpu_torch.ssl.dino_head, dfd_clip_tpu_torch.ssl.losses, "
    "dfd_clip_tpu_torch.ssl.masking, dfd_clip_tpu_torch.ssl.samplers, "
    "dfd_clip_tpu_torch.ssl.augmentations, dfd_clip_tpu_torch.ssl.schedules, "
    "dfd_clip_tpu_torch.ssl.data_adapters, dfd_clip_tpu_torch.ssl.evals, "
    "dfd_clip_tpu_torch.ssl_train, dfd_clip_tpu_torch.ssl_eval",
], ids=["serve", "train", "towers", "tools", "zero_shot", "eval", "cli", "ssl"])
def test_importing_the_port_loads_no_jax_or_yaml(modules):
    code = ("import sys\n"
            f"import {modules}\n"
            "print(sorted(m for m in ('jax', 'optax', 'yaml', 'cv2', 'dfd_clip_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["resolve_device", "Detector", "Trainer",
                                   "Scorer.from_preset", "inference.main", "main.main",
                                   "CompInvEncoder", "CompInvTrainer", "SSLTrainer",
                                   "ssl_train.main", "ssl_eval.main", "ssl.evals",
                                   "analysis.main"])
def test_default_device_is_the_card(entry):
    """Detector (whose forward and predict run on its device), Trainer, the
    run-directory Scorer, the evaluation CLI, the training CLI, the CompInv
    pretrainer's model and trainer, the SSL trainer, both SSL CLIs, the
    SSL evaluations' classifiers and the encoder-analysis CLI default to
    the card."""
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
        elif entry == "main.main":
            from dfd_clip_tpu_torch import main

            main.main(main.parse_args(["--cfg", "/nonexistent.yaml"]))
        elif entry == "SSLTrainer":
            from dfd_clip_tpu_torch.runtime import OneProcess
            from dfd_clip_tpu_torch.ssl import SSLTrainer

            SSLTrainer(SSLTrainer.get_default_config(), OneProcess(), [])
        elif entry.startswith("ssl_"):
            from dfd_clip_tpu_torch import ssl_eval, ssl_train

            mod = ssl_train if entry == "ssl_train.main" else ssl_eval
            argv = (["--synthetic", "2"] if mod is ssl_train else
                    ["--weights", "/nonexistent", "--train_dir", "/x", "--test_dir", "/y"])
            mod.main(mod.parse_args(argv))
        elif entry == "analysis.main":
            from dfd_clip_tpu_torch.tools import analysis

            analysis.main(["comb-impact", "--inputs", "/nonexistent", "--weights", "1"])
        elif entry == "ssl.evals":
            from dfd_clip_tpu_torch.ssl import evals

            evals.knn_classify(np.zeros((2, 4), np.float32), np.array([0, 1]),
                               np.zeros((1, 4), np.float32))
        elif entry.startswith("CompInv"):
            from dfd_clip_tpu_torch.engine import CompInvTrainer
            from dfd_clip_tpu_torch.models import CompInvEncoder

            ccfg = CompInvEncoder.get_default_config()
            ccfg.merge_from_other_cfg({"architecture": "ViT-Test",
                                       "adapter": {"struct": {"type": "768-x-768", "x": 8}}})
            if entry == "CompInvEncoder":
                CompInvEncoder(ccfg, num_frames=4)
            else:
                CompInvTrainer(CompInvTrainer.get_default_config(),
                               CompInvEncoder(ccfg, num_frames=4, device="cpu"), {})
        else:
            Trainer(Trainer.get_default_config(), Detector(cfg, num_frames=4, device="cpu"), {})
    assert resolve_device("cpu").type == "cpu"


def test_unported_options_raise():
    """kv_dtype "int8" (per-(layer, head) scales) is ported: the Detector
    builds and its export comes back dequantised in the compute dtype
    (tests/test_torch_port_options.py holds it to JAX's); an adapter struct
    the JAX package does not know still raises."""
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"architecture": "ViT-Test", "decode_mode": "index",
                              "decode_indices": [0], "out_dim": [2],
                              "op_mode": {"kv_dtype": "int8"}})
    det = Detector(cfg, num_frames=4, compute_dtype=torch.float32, device="cpu")
    params = det.prepare_params(det.init_params(torch.Generator().manual_seed(0)))
    kvs = det.encode_kv(params, torch.zeros(2, 4, 3, 32, 32), pad_tokens=True)
    assert set(kvs) == {"k", "v"} and kvs["k"].dtype == torch.float32
    assert kvs["k"].shape == (1, 2, 4, 8, 4, 16) and torch.isfinite(kvs["v"]).all()
    # the adapter is ported (tests/test_torch_port_adapter.py); a struct
    # type the JAX package does not know raises
    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"decode_mode": "index", "decode_indices": [0], "out_dim": [2],
                              "adapter": {"type": "normal", "struct": {"type": "768-x-9"}}})
    with pytest.raises(NotImplementedError):
        Detector(cfg, num_frames=4, device="cpu")


@pytest.mark.parametrize("option", [{"train_mode": {"compression": "sync"},
                                     "adapter": {"type": "normal",
                                                 "struct": {"type": "768-x-768", "x": 32}}},
                                    {"train_mode": {"temporal": "ranking"}},
                                    {"train_mode": {"patch_mask": {"type": "batch",
                                                                   "ratio": 0.5}}},
                                    {"op_mode": {"ema_frame": 0.5}},
                                    {"op_mode": {"compute_int8": 1}},
                                    {"op_mode": {"kv_dtype": "int8_rows"}}],
                         ids=["compression", "temporal", "patch_mask", "ema_frame",
                              "compute_int8", "int8_rows"])
def test_unported_train_modes_raise(option):
    """Every training mode builds and a CPU train forward returns the task
    loss and the mode's auxiliary losses: compression, temporal,
    patch_mask and ema_frame (tests/test_torch_port_train_modes.py holds
    them to JAX's), and training with compute_int8 or int8_rows K/V
    (tests/test_torch_port_options.py)."""
    from dfd_clip_tpu_torch.models.detector import Detector

    cfg = Detector.get_default_config()
    cfg.merge_from_other_cfg({"architecture": "ViT-Test", "decode_mode": "index",
                              "decode_indices": [0], "out_dim": [2], "losses": ["auc_roc"],
                              **option})
    det = Detector(cfg, num_frames=4, compute_dtype=torch.float32, device="cpu")
    x, m = torch.zeros(2, 4, 3, 32, 32), torch.ones(2, 4, dtype=torch.bool)
    params = det.prepare_params(det.init_params(torch.Generator().manual_seed(0)))
    losses, _, other = det.forward(
        params, x, [torch.tensor([0, 1])], m, torch.tensor([True, False]),
        torch.tensor([0.6, 0.9]), train=True, single_task=0,
        patch_indices=det.sample_patch_indices(np.random.default_rng(0)))
    assert torch.isfinite(losses[0]).all()
    want = {"compression": {"recon", "match"},
            "temporal": {"speed/rank"}}.get(next(iter(option.get("train_mode", {})), ""), set())
    assert set(other) == want and all(torch.isfinite(v) for v in other.values())


@pytest.mark.parametrize("option", ["swiglu_ffn", "foundation"])
def test_unported_tower_options_raise(option):
    """Unknown foundations raise; giant2's fused SwiGLU FFN is ported: its
    hidden width is 4096 at ViT-g/14's 1536, and a tiny SwiGLU tower builds
    w12 / w3 and exports finite K/V (tests/test_torch_port_options.py holds
    it to JAX's). W8A8 towers wider than 1024 are ported too
    (tests/test_torch_port_int8_wide.py)."""
    from dfd_clip_tpu_torch.models import dinov2_vit
    from dfd_clip_tpu_torch.models.detector import Detector

    if option == "swiglu_ffn":
        assert dinov2_vit.ARCHITECTURES["ViT-g/14"].swiglu_hidden == 4096
        cfg = dinov2_vit.ARCHITECTURES["ViT-Test-SwiGLU"]
        params = dinov2_vit.init_dinov2(torch.Generator().manual_seed(0), cfg)
        mlp = params["blocks"][0]["mlp"]
        assert mlp["w12"]["w"].shape == (32, 2 * cfg.swiglu_hidden) and "c_fc" not in mlp
        kv = dinov2_vit.dinov2_kv(params, torch.zeros(2, 3, 28, 28), cfg, torch.float32)
        assert kv["k"].shape == (2, 2, 5, 2, 16) and torch.isfinite(kv["k"]).all()
        return
    with pytest.raises(NotImplementedError):
        cfg = Detector.get_default_config()
        cfg.merge_from_other_cfg({"foundation": "resnet", "decode_mode": "index",
                                  "decode_indices": [0], "out_dim": [2]})
        Detector(cfg, num_frames=4, device="cpu")
