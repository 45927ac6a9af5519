from peclr_tpu_torch.models.heads import Denoiser
from peclr_tpu_torch.models.peclr import PeCLRModel
from peclr_tpu_torch.models.resnet import ResNetPose
from peclr_tpu_torch.models.rn25d import K_DEFAULT, RN25DPose

__all__ = ["Denoiser", "K_DEFAULT", "PeCLRModel", "RN25DPose", "ResNetPose"]
