from gaussiansplatting_tpu_torch.models.gaussian_model import GaussianModel

__all__ = ["GaussianModel"]
