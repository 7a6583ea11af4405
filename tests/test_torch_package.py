"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``repro`` (the port keeps its own copies of the host-side modules it
needs).  An AST scan, so a lazy import inside a function counts too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    assert (ROOT / "chip_smoke.py").exists()
    names = {p.name for p in FILES}
    assert {"engine.py", "mux_server.py", "ops.py", "transformer.py",
            "flash_attention.py", "backend.py", "runtime.py", "request.py",
            "metrics.py", "batcher.py", "traffic.py", "tracer.py",
            "gauges.py", "mamba.py", "selective_scan.py", "serve.py",
            "falcon_mamba_7b.py", "graphs.py", "cnn.py", "paper_mux.py",
            "admission.py", "synthetic.py", "adamw.py", "contrastive.py",
            "ensemble.py", "mux_train.py", "offload.py", "ckpt.py",
            "tree.py", "table1_mobile_cloud.py", "table2_cloud_api.py",
            "fig1_expertise.py", "fig6_separation.py", "__main__.py"} <= names
    assert (ROOT / "src" / "repro_torch" / "launch" / "serve.py") in FILES
    assert (ROOT / "src" / "repro_torch" / "paper" / "common.py") in FILES
    assert not _forbidden("repro_torch.kernels")
    assert _forbidden("repro.kernels") and _forbidden("jax.numpy")


def test_entry_points_default_to_cuda_and_refuse_without_it(monkeypatch):
    """With no device given, every entry point asks for CUDA; with no
    CUDA present it raises instead of running on the CPU."""
    import torch

    from repro_torch.configs import get_smoke_config, paper_mux
    from repro_torch.core import contrastive, mux_train
    from repro_torch.core.multiplexer import (init_image_backbone, init_mux,
                                              init_token_backbone)
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    from repro_torch.models import transformer as tf
    from repro_torch.data import synthetic
    from repro_torch.paper import __main__ as paper_main
    from repro_torch.paper import common
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.mux_server import MuxServer
    from repro_torch.serving.scheduler import MuxScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("olmo-1b").with_(num_layers=1, d_model=32,
                                            d_ff=32, vocab_size=16,
                                            num_heads=2, num_kv_heads=2,
                                            head_dim=16)
    params = tf.init_params(cfg, device="cpu")
    backbone = init_token_backbone(meta_dim=4, vocab_size=16, d_model=8,
                                   num_layers=1, device="cpu")
    mux = init_mux(backbone=backbone, model_names=["a"], costs={"a": 1.0},
                   meta_dim=4, proj_dim=2, device="cpu")
    image_mux = init_mux(
        backbone=init_image_backbone(meta_dim=4, device="cpu"),
        model_names=["a"], costs={"a": 1.0}, meta_dim=4, proj_dim=2,
        device="cpu")
    fns = [lambda b: b]
    calls = [
        lambda: tf.init_params(cfg),
        lambda: tf.init_caches(cfg, num_pages=2, page_size=4),
        lambda: Engine(cfg, params, ServeConfig()),
        lambda: init_token_backbone(meta_dim=4, vocab_size=16),
        lambda: init_mux(backbone=backbone, model_names=["a"],
                         costs={"a": 1.0}, meta_dim=4, proj_dim=2),
        lambda: MuxServer(mux, [1.0]),
        lambda: MuxServer(image_mux, [1.0], model_fns=fns),
        lambda: MuxScheduler(MuxServer(image_mux, [1.0], model_fns=fns)),
        lambda: cnn.init_cnn(widths=(4,)),
        lambda: cnn.init_zoo(),
        lambda: cnn.init_mux_backbone(meta_dim=4),
        lambda: init_image_backbone(meta_dim=4),
        lambda: tf.init_caches(cfg, 1, 8),
        lambda: serve.main(["--smoke", "--tokens", "1"]),
        lambda: serve.build_engine("falcon-mamba-7b", smoke=True, max_len=8),
        lambda: synthetic.make_templates(),
        lambda: contrastive.init_projections(None, {"a": 4}, 2),
        lambda: mux_train.init_zoo_state(None, paper_mux.config()),
        lambda: mux_train.init_mux_state(None, paper_mux.config()),
        lambda: mux_train.train_zoo(None, paper_mux.config(), [{}]),
        lambda: common.get_state(scale="smoke", cache_dir=None),
        lambda: paper_main.main(["--scale", "smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
