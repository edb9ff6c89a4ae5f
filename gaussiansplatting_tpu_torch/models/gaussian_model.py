"""High-level model facade: the user-facing API of the framework.

Counterpart of gaussiansplatting_tpu/models/gaussian_model.py (reference:
MTLEngine, mtl_engine.hpp:40-57): construct from a COLMAP scene or a 3DGS
PLY, render any camera, train, checkpoint, export, over the ported
``train_loop``, ``io/`` and ``train/checkpoint``.  A model lives on one
torch ``device``; every constructor puts it on the card unless the caller
asks for the CPU (``device="cpu"``).

    model = GaussianModel.from_ply("scene.ply")
    img = model.render(camera)

    model, cameras, gts = GaussianModel.from_colmap_scene("scene/sparse/0", "scene/images")
    model.train(cameras, gts, epochs=155)
    model.save_ply("out.ply")
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from gaussiansplatting_tpu_torch.config import Config
from gaussiansplatting_tpu_torch.core.camera import Camera
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams, from_arrays
from gaussiansplatting_tpu_torch.train.state import TrainState


@dataclasses.dataclass
class GaussianModel:
    state: TrainState
    config: Config
    scene_extent: float = 1.0
    device: torch.device = torch.device("cuda")

    # ------------------------------------------------------------- creation

    @classmethod
    def from_params(
        cls, params: GaussianParams, config: Config | None = None,
        scene_extent: float = 1.0, seed: int = 0, device="cuda",
    ) -> "GaussianModel":
        """A model of ``params`` (copied to ``device``, or taken as they are
        where they already lie there)."""
        from gaussiansplatting_tpu_torch.train import state as state_mod

        device = torch.device(device)
        if params.means.device != device:
            params = copy.deepcopy(params).to(device)
        return cls(state=state_mod.create(params, seed=seed), config=config or Config(),
                   scene_extent=scene_extent, device=device)

    @classmethod
    def from_ply(
        cls, path: str, config: Config | None = None, capacity: int | None = None,
        device="cuda",
    ) -> "GaussianModel":
        from gaussiansplatting_tpu_torch.io import ply as ply_mod

        cloud = ply_mod.load_gaussian_ply(path)
        params = from_arrays(
            cloud.means, cloud.log_scales, cloud.quats,
            cloud.raw_opacities, cloud.sh, capacity=capacity, device=device,
        )
        return cls.from_params(params, config, device=device)

    @classmethod
    def from_colmap(
        cls,
        colmap_dir: str,
        config: Config | None = None,
        capacity: int | None = None,
        knn_mode: str = "reference",
        device="cuda",
    ) -> "GaussianModel":
        """Initialize from SfM points exactly like the reference program
        (gaussiansFromColmap, main.mm:59-187)."""
        from gaussiansplatting_tpu_torch.io import colmap as colmap_mod
        from gaussiansplatting_tpu_torch.io import init as init_mod

        cfg = config or Config()
        data = colmap_mod.load_colmap(colmap_dir)
        extent = colmap_mod.compute_scene_extent(data, cfg.init.extent_multiplier)
        cloud = init_mod.gaussians_from_points(
            data.points, data.point_colors, extent, cfg.init, knn_mode=knn_mode,
            sh_degree=cfg.raster.sh_degree,
        )
        params = from_arrays(
            cloud.means, cloud.log_scales, cloud.quats,
            cloud.raw_opacities, cloud.sh, capacity=capacity, device=device,
        )
        return cls.from_params(params, cfg, scene_extent=extent, device=device)

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda") -> "GaussianModel":
        """A checkpoint of either package (train/checkpoint's format)."""
        from gaussiansplatting_tpu_torch.train import checkpoint as ckpt_mod

        device = torch.device(device)
        state, cfg = ckpt_mod.load(path, device)
        return cls(state=state, config=cfg or Config(), device=device)

    @classmethod
    def from_colmap_scene(
        cls, colmap_dir: str, images_dir: str,
        config: Config | None = None, downscale: int = 1,
        capacity: int | None = None, device="cuda",
    ) -> tuple["GaussianModel", list, list]:
        """One-call dataset + model assembly: returns (model, cameras,
        gt_images) ready for ``model.train(cameras, gt_images)``; the
        cameras on ``device``, the images host arrays."""
        from gaussiansplatting_tpu_torch.io.dataset import load_colmap_scene

        cfg = config or Config()
        scene = load_colmap_scene(
            colmap_dir, images_dir, cfg, downscale=downscale, capacity=capacity,
            device=device,
        )
        model = cls.from_params(scene.params, cfg, scene_extent=scene.extent, device=device)
        return model, scene.cameras, scene.gt_images

    # ------------------------------------------------------------ inference

    @property
    def params(self) -> GaussianParams:
        return self.state.params

    @property
    def num_gaussians(self) -> int:
        return int(self.state.params.alive.sum())

    def render(self, camera: Camera) -> np.ndarray:
        """Render one view to a [H, W, 3] float32 host array (on the card a
        replay of the render's CUDA graph, train/graph.render_frame)."""
        from gaussiansplatting_tpu_torch.train.graph import render_frame

        img, _ = render_frame(self.state.params, camera.to(self.device), self.config.raster)
        return img.cpu().numpy()

    # ------------------------------------------------------------- training

    def train(
        self,
        cameras: list[Camera],
        gt_images: list,
        epochs: int | None = None,
        devices: int = 1,
        log_fn=None,
        metrics_fn=None,
    ) -> "GaussianModel":
        """train_loop over the views (ground truth as host arrays or
        tensors, moved to the model's device); ``devices`` > 1 shards tile
        strips over that many ranks of the initialized torch.distributed
        process group (parallel/; every rank calls train with the same
        arguments), and raises without one."""
        from gaussiansplatting_tpu_torch.train import trainer

        self.state = trainer.train_loop(
            self.state, [c.to(self.device) for c in cameras],
            [torch.as_tensor(g, device=self.device) for g in gt_images],
            self.config, self.scene_extent,
            num_epochs=epochs, log_fn=log_fn, metrics_fn=metrics_fn,
            mesh_devices=devices,
        )
        return self

    # ----------------------------------------------------------------- save

    def save_ply(self, path: str) -> int:
        from gaussiansplatting_tpu_torch.io import ply as ply_mod

        return ply_mod.export_gaussian_ply(
            path, ply_mod.cloud_from_params(self.state.params)
        )

    def save_checkpoint(self, path: str) -> None:
        from gaussiansplatting_tpu_torch.train import checkpoint as ckpt_mod

        ckpt_mod.save(path, self.state, self.config)
