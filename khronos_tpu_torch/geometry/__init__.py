from khronos_tpu_torch.geometry.camera import Camera
from khronos_tpu_torch.geometry import bbox, transforms

__all__ = ["Camera", "bbox", "transforms"]
