from peclr_tpu_torch.models.rn25d import K_DEFAULT, RN25DPose

__all__ = ["K_DEFAULT", "RN25DPose"]
