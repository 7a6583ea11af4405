"""The paper's own experiment config: the 6-CNN zoo and the 4-conv
multiplexer.

Port of ``repro.configs.paper_mux``: six CNNs spanning about two orders
of magnitude of FLOPs (the alexnet ... resnext101 analogue), a
mobile/cloud pair, and the multiplexer's hyperparameters (§III).
"""
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.models.cnn import ZOO_SPECS, zoo_costs


@dataclass(frozen=True)
class MuxExperimentConfig:
    name: str = "paper-mux"
    image_size: int = 32
    num_classes: int = 10
    zoo: Tuple[str, ...] = tuple(ZOO_SPECS)
    # mobile/cloud pair: chosen so the cloud model has a real accuracy
    # margin at benchmark training scale (zoo_xl needs paper-scale
    # epochs to pull ahead; zoo_m already does at bench scale)
    mobile_model: str = "zoo_xs"         # mobilenet_v2 analogue
    cloud_model: str = "zoo_m"           # resnext101_32x8d analogue
    meta_dim: int = 64                   # multiplexer meta-feature dim (M)
    proj_dim: int = 32                   # projected-embedding dim (h_i output)
    contrastive_coef: float = 0.5
    distill_coef: float = 0.5
    ensemble_threshold: float = 0.288    # paper's swept threshold (Table II)
    offload_threshold: float = 0.5       # mobile/cloud binarisation
    # training
    train_samples: int = 8192
    eval_samples: int = 2048
    batch_size: int = 256
    zoo_steps: int = 500
    mux_steps: int = 500
    lr: float = 3e-3
    seed: int = 0
    # paper Table I cost model (per-inference, mobile side)
    upload_bytes: int = 32 * 32 * 3      # raw input upload
    uplink_bps: float = 26.1e6           # Ookla 2019 US mobile uplink
    downlink_bps: float = 33.9e6
    mobile_flops_per_s: float = 1.33e12  # Jetson TX2 GPU peak
    cloud_flops_per_s: float = 11.3e12   # GTX 1080Ti peak
    mobile_w: float = 7.5                # Jetson TX2 board power
    net_w: float = 1.2                   # radio power while transmitting

    def costs(self) -> Dict[str, float]:
        return zoo_costs(self.zoo, image_size=self.image_size,
                         num_classes=self.num_classes)


def config() -> MuxExperimentConfig:
    return MuxExperimentConfig()


def smoke_config() -> MuxExperimentConfig:
    return MuxExperimentConfig(
        name="paper-mux-smoke", train_samples=512, eval_samples=256,
        batch_size=64, zoo_steps=30, mux_steps=30)
